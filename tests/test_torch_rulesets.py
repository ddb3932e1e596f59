"""Custom secret rulesets shared by the port's matcher tests and
``chip_smoke.py``, with one sample secret per rule.

``RULESETS`` maps a name to ``(rules, samples)``: the rules as a
``--secret-config`` lists them (with ``enable-builtin-rules: []``), and
samples that the matcher must flag. The module imports neither ``jax`` nor
``trivy_tpu``, so ``chip_smoke.py`` loads it by path on a machine without
JAX. Its one test holds every sample to being found by the port's exact
engine.
"""

RULESETS = {
    # the all-host-lane and all-anchored cases of the Pallas tests
    "host_only": (
        [{"id": "host-only", "regex": r"(?:\d+[a-z]\d+){1,9}zz", "keywords": [],
          "severity": "LOW"}],
        ["12a34zz"],
    ),
    "anchored_only": (
        [{"id": "anchored-only", "regex": r"AKIA[0-9A-Z]{16}", "severity": "HIGH"}],
        ["AKIAQWERTYUIOPASDFGHJ"],
    ),
    # the latin-1 space and DOTALL rules of the scanner tests
    "latin1_dotall": (
        [{"id": "nbsp-rule", "regex": r"SECRETKEY\s[0-9a-f]{32}", "keywords": [],
          "severity": "HIGH"},
         {"id": "dotall-rule", "regex": r"(?s)KEYSTART.[0-9a-f]{8}", "keywords": [],
          "severity": "HIGH"}],
        ["SECRETKEY\xa0" + "f" * 32, "KEYSTART\nabcdef01"],
    ),
    # a negated class, negative check offsets and a 130-byte class run
    "edges": (
        [{"id": "neg", "regex": r"[^x\n]{3}zqk_[0-9a-f]{12}", "keywords": ["zqk_"],
          "severity": "HIGH"},
         {"id": "long", "regex": r"(?:^|[^0-9A-Za-z])(LONGTOK[A-Za-z0-9]{130})",
          "keywords": ["longtok"], "severity": "HIGH"},
         {"id": "negd", "regex": r"[0-9]{4}-SECRETX-[a-z]{5}", "keywords": ["secretx"],
          "severity": "HIGH"},
         {"id": "kwonly", "regex": r"(?i)passw[o0]rd\s*=\s*\S{8,}", "keywords": ["passw"],
          "severity": "HIGH"}],
        ["abczqk_0123456789ab", "LONGTOK" + "Ab1" * 43 + "x", "1234-SECRETX-abcde",
         "PassWord = hunter2hunter2"],
    ),
    # keywords shorter than the CUDA kernel's four screened bytes and a
    # 3-byte anchor, sampled in mixed case
    "short": (
        [{"id": "one", "regex": r"(?i)x[0-9]{4}", "keywords": ["x"], "severity": "LOW"},
         {"id": "two", "regex": r"(?i)qz=[a-z]{5}", "keywords": ["qz"], "severity": "LOW"},
         {"id": "three", "regex": r"ABC[0-9]{4}", "severity": "LOW"}],
        ["X1234", "qZ=hello", "ABC1234"],
    ),
}


def config(name: str) -> dict:
    """The ``--secret-config`` document of ruleset ``name``: its rules
    alone, no built-ins."""
    return {"enable-builtin-rules": [], "rules": RULESETS[name][0]}


def test_every_sample_is_found_by_its_ruleset():
    """Each sample, on a line of its own, is reported by the port's exact
    engine under the rule it was written for."""
    from trivy_tpu_torch.secret.engine import ScannerConfig, SecretScanner

    for name, (rules, samples) in RULESETS.items():
        engine = SecretScanner(ScannerConfig.from_dict(config(name)))
        assert len(rules) == len(samples), name
        for rule, sample in zip(rules, samples):
            data = f"first line\n{sample}\nlast line\n".encode("latin-1")
            found = {f.rule_id for f in engine.scan_bytes("app/settings.txt", data).findings}
            assert rule["id"] in found, (name, rule["id"], found)
