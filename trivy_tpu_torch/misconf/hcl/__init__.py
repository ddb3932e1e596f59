"""HCL2 parsing and evaluation for terraform scanning
(ref: pkg/iac/scanners/terraform/parser/ — independent implementation).

The port of ``trivy_tpu/misconf/hcl/__init__.py``.
"""

from trivy_tpu_torch.misconf.hcl.evaluator import Evaluator, truthy  # noqa: F401
from trivy_tpu_torch.misconf.hcl.functions import UNKNOWN, EvalError, is_unknown  # noqa: F401
from trivy_tpu_torch.misconf.hcl.parser import Body, Block, Attribute, parse, parse_expression  # noqa: F401
from trivy_tpu_torch.misconf.hcl.lexer import HclSyntaxError  # noqa: F401
