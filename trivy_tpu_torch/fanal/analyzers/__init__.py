"""The port's per-file analyzers; importing this package registers them all
(ref: each reference analyzer registers via init(), pkg/fanal/analyzer).
The secret, license and config analyzers are batched and live in
``fanal/secret.py``, ``fanal/license.py`` and ``fanal/config.py``."""

from trivy_tpu_torch.fanal.analyzers import (  # noqa: F401
    binary,
    buildinfo,
    installed,
    lang,
    os_release,
    pkg_apk,
    pkg_dpkg,
    pkg_rpm,
    sbom_file,
)
