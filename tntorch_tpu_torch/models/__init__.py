"""Model families: matrix-free linear operators in TT and CP format
(`matrix`: ``TTMatrix``, ``CPMatrix``, ``tt_multiply``, ``cp_multiply``)
and supervised TT-Tucker learners (`TTRegressor`, `TTClassifier`)."""

from tntorch_tpu_torch.models import matrix
from tntorch_tpu_torch.models.learners import TTClassifier, TTRegressor
from tntorch_tpu_torch.models.matrix import CPMatrix, TTMatrix, cp_multiply, tt_multiply
