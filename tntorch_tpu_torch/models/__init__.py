"""Model families: supervised TT-Tucker learners (`TTRegressor`,
`TTClassifier`). The matrix-free operators of the JAX package's
``models/matrix.py`` (``TTMatrix``, ``CPMatrix``, ``tt_multiply``,
``cp_multiply``) are not ported yet and raise ``NotImplementedError``
(ROADMAP.md, queue 1 item 10)."""

from tntorch_tpu_torch.models.learners import TTClassifier, TTRegressor
from tntorch_tpu_torch.tensor import _not_ported_module, _not_ported_stub

matrix = _not_ported_module("models.matrix", "queue 1 item 10")
TTMatrix, CPMatrix, tt_multiply, cp_multiply = (
    _not_ported_stub(name, "queue 1 item 10")
    for name in ("TTMatrix", "CPMatrix", "tt_multiply", "cp_multiply"))
