"""Matrix-free linear operators in TT-matrix and CP-matrix format.

Counterpart of ``tntorch_tpu/models/matrix.py``. An I x O matrix with
I = prod(i_j) and O = prod(o_j) is reshaped so that each (i_j, o_j) pair
is one mode and then compressed: `TTMatrix` by TT-SVD to given ranks
(cores r_{j-1} x i_j x o_j x r_j, a leading batch axis for a batch of
matrices), `CPMatrix` by CP-ALS (cores i_j x o_j x R). ``tt_multiply`` and
``cp_multiply`` apply them to (a batch of) vectors as a chain of einsums,
never forming the matrix. A Kronecker `TTMatrix` (all ranks 1, square
blocks) has its determinant, inverse and Cholesky factor from its blocks.
Matrices without a device (NumPy) land on the card; torch tensors stay
where they are.
"""

from __future__ import annotations

import numpy as np
import torch

from tntorch_tpu_torch.tensor import Tensor
from tntorch_tpu_torch.utils import asarray, policy_precision


def _interleave(M, input_dims, output_dims, batch: bool):
    """(B,) I x O -> (B,) i_0 o_0 x ... x i_{d-1} o_{d-1}."""
    d = len(input_dims)
    lead = [M.shape[0]] if batch else []
    tensor = M.reshape(lead + list(input_dims) + list(output_dims))
    dims = list(range(len(lead), len(lead) + 2 * d))
    order = [a for pair in zip(dims[:d], dims[d:]) for a in pair]
    tensor = tensor.permute(list(range(len(lead))) + order)
    return tensor.reshape(lead + [int(i) * int(o) for i, o in zip(input_dims, output_dims)])


def _deinterleave(tensor, input_dims, output_dims, batch: bool):
    """The inverse of `_interleave`, to (B,) I x O."""
    d = len(input_dims)
    lead = [tensor.shape[0]] if batch else []
    shape = [int(a) for pair in zip(input_dims, output_dims) for a in pair]
    tensor = tensor.reshape(lead + shape)
    dims = list(range(len(lead), len(lead) + 2 * d))
    tensor = tensor.permute(list(range(len(lead))) + dims[0::2] + dims[1::2])
    return tensor.reshape(lead + [int(np.prod(input_dims)), int(np.prod(output_dims))])


def _check_dims(input_dims, output_dims):
    if len(input_dims) != len(output_dims) or len(input_dims) == 0:
        raise ValueError("input_dims and output_dims need one entry per core, the same count")


class TTMatrix:
    """An I x O matrix (or a batch of them) as d TT cores of shape r_{j-1}
    x i_j x o_j x r_j: from a list of such cores (5-D for a batch), or from
    a dense (B,) I x O matrix by TT-SVD to ``ranks`` (d - 1 entries)."""

    def __init__(self, t, ranks, input_dims, output_dims):
        _check_dims(input_dims, output_dims)
        self.input_dims = np.asarray(input_dims)
        self.output_dims = np.asarray(output_dims)
        self.d = len(input_dims)
        if isinstance(t, list):
            if t[0].ndim not in (4, 5):
                raise ValueError("TT-matrix cores have 4 dimensions, 5 in a batch")
            self.batch = t[0].ndim == 5
            self.cores = [asarray(c) for c in t]
            self.ranks = np.array([c.shape[-1] for c in self.cores[:-1]])
            return
        if not isinstance(ranks, list) or len(ranks) != self.d - 1:
            raise ValueError(f"ranks needs a list of {self.d - 1} entries")
        M = asarray(t)
        if M.ndim not in (2, 3):
            raise ValueError("the matrix must be I x O, or B x I x O for a batch")
        self.batch = M.ndim == 3
        if (int(np.prod(self.input_dims)) != M.shape[-2]
                or int(np.prod(self.output_dims)) != M.shape[-1]):
            raise ValueError("the matrix's shape is not prod(input_dims) x prod(output_dims)")
        tt = Tensor(_interleave(M, input_dims, output_dims, self.batch), ranks_tt=ranks,
                    batch=self.batch)
        self.ranks = tt.ranks_tt[1:-1]
        self.cores = [c.reshape(c.shape[:-2] + (int(input_dims[i]), int(output_dims[i]),
                                                c.shape[-1]))
                      for i, c in enumerate(tt.cores)]

    def full(self) -> torch.Tensor:
        """The dense (batch of) matrix."""
        return _deinterleave(self.flatten().full(), self.input_dims, self.output_dims,
                             self.batch)

    def torch(self) -> torch.Tensor:
        return self.full()

    def numpy(self) -> np.ndarray:
        return self.full().detach().cpu().numpy()

    def to(self, device):
        """Move the cores to ``device``, in place; returns self."""
        self.cores = [c.to(device) for c in self.cores]
        return self

    def trace(self):
        """The trace, by contracting each core's diagonal."""
        c0 = self.cores[0]
        factor = torch.ones((c0.shape[0], 1) if self.batch else (1,), dtype=c0.dtype,
                            device=c0.device)
        for c in self.cores:
            factor = torch.einsum("...i,...iaaj->...j", factor, c)
        return factor[..., 0]

    def flatten(self) -> Tensor:
        """The cores with each (i_j, o_j) pair as one mode: a `Tensor`."""
        return Tensor([c.reshape(c.shape[:-3] + (-1, c.shape[-1])) for c in self.cores],
                      batch=self.batch)

    def _kron_blocks(self) -> list:
        """The square blocks of a Kronecker product (all ranks 1), or
        raises."""
        if len(self.ranks) and max(self.ranks) != 1:
            raise ValueError("The argument should be a Kronecker product (tt-ranks should be 1)")
        if not np.array_equal(self.input_dims, self.output_dims):
            raise ValueError("The argument should be a Kronecker product of square matrices "
                             "(tt-cores must be square)")
        return [c[..., 0, :, :, 0] for c in self.cores]

    def determinant(self):
        """The determinant of a Kronecker TT-matrix: the product of each
        block's determinant to the power of the other blocks' size."""
        rows = int(np.prod(self.input_dims))
        det = 1.0
        for n, block in enumerate(self._kron_blocks()):
            det = det * torch.linalg.det(block) ** (rows / int(self.input_dims[n]))
        return det

    def slog_determinant(self):
        """(sign, log |det|) of a Kronecker TT-matrix."""
        rows = int(np.prod(self.input_dims))
        logdet, sign = 0.0, 1.0
        for n, block in enumerate(self._kron_blocks()):
            power = rows / int(self.input_dims[n])
            s, ld = torch.linalg.slogdet(block)
            logdet = logdet + ld * power
            sign = sign * s ** power
        return sign, logdet

    def _from_blocks(self, blocks) -> "TTMatrix":
        return TTMatrix([b.unsqueeze(-3)[..., None] for b in blocks], None,
                        list(self.input_dims), list(self.output_dims))

    def inv(self) -> "TTMatrix":
        """The inverse of a Kronecker TT-matrix, block by block."""
        return self._from_blocks([torch.linalg.inv(b) for b in self._kron_blocks()])

    def cholesky(self) -> "TTMatrix":
        """The lower Cholesky factor of a symmetric positive definite
        Kronecker TT-matrix, block by block. A TT's blocks are fixed up to
        scale and sign: blocks of negative trace are negated in pairs, and
        an odd count of them (a matrix that is not SPD) raises."""
        blocks = self._kron_blocks()
        if not self.batch:
            negs = [i for i, b in enumerate(blocks) if float(torch.trace(b)) < 0]
            if len(negs) % 2:
                raise ValueError("cholesky requires an SPD matrix: an odd number of "
                                 "Kronecker blocks have negative trace")
            blocks = [-b if i in negs else b for i, b in enumerate(blocks)]
        return self._from_blocks([torch.linalg.cholesky(b) for b in blocks])


class CPMatrix:
    """An I x O matrix as d CP cores of shape i_j x o_j x R, from a dense
    I x O matrix by CP-ALS of rank ``rank``."""

    def __init__(self, M, rank, input_dims, output_dims, batch_size: int = 1,
                 verbose: bool = False):
        _check_dims(input_dims, output_dims)
        if not isinstance(rank, int):
            raise ValueError("rank must be an int")
        M = asarray(M)
        if M.ndim != 2:
            raise ValueError("the matrix must be I x O")
        self.rank = rank
        self.input_dims = np.asarray(input_dims)
        self.output_dims = np.asarray(output_dims)
        self.batch_size = batch_size
        if (int(np.prod(self.input_dims)) != M.shape[0]
                or int(np.prod(self.output_dims)) != M.shape[1]):
            raise ValueError("the matrix's shape is not prod(input_dims) x prod(output_dims)")
        self.d = len(input_dims)
        cp = Tensor(_interleave(M, input_dims, output_dims, False), ranks_cp=rank,
                    verbose=verbose)
        self.cores = [c.reshape(int(input_dims[i]), int(output_dims[i]), c.shape[-1])
                      for i, c in enumerate(cp.cores)]

    def full(self) -> torch.Tensor:
        """The dense matrix."""
        t = Tensor([c.reshape(-1, c.shape[-1]) for c in self.cores]).full()
        return _deinterleave(t, self.input_dims, self.output_dims, False)

    def torch(self) -> torch.Tensor:
        return self.full()

    def numpy(self) -> np.ndarray:
        return self.full().detach().cpu().numpy()

    def to(self, device):
        """Move the cores to ``device``, in place; returns self."""
        self.cores = [c.to(device) for c in self.cores]
        return self


def _vectors(matrix, tensor):
    """(b, I) rows of ``tensor`` (any shape of b * I entries, ndim > 1),
    transposed to (I, b), on the matrix's device."""
    tensor = asarray(tensor, device=matrix.cores[0].device)
    if tensor.ndim < 2:
        raise ValueError("the vectors need a leading batch axis")
    rows = int(np.prod(matrix.input_dims))
    return tensor.reshape(-1, rows).T


@policy_precision
def tt_multiply(tt_matrix: TTMatrix, tensor) -> torch.Tensor:
    """The rows of ``tensor`` (b vectors of length I) times the TT-matrix:
    (b, O)."""
    x = _vectors(tt_matrix, tensor)
    b = x.shape[1]
    result = torch.einsum("id,lior->ldor", x.reshape(int(tt_matrix.input_dims[0]), -1),
                          tt_matrix.cores[0])
    for d in range(1, tt_matrix.d):
        result = result.reshape(int(tt_matrix.input_dims[d]), -1, tt_matrix.cores[d].shape[0])
        result = torch.einsum("idr,riob->dob", result, tt_matrix.cores[d])
    return result.reshape(b, -1)


@policy_precision
def cp_multiply(cp_matrix: CPMatrix, tensor) -> torch.Tensor:
    """The rows of ``tensor`` (b vectors of length I) times the CP-matrix:
    (b, O)."""
    x = _vectors(cp_matrix, tensor)
    b = x.shape[1]
    result = torch.einsum("ij,ior->jor", x.reshape(int(cp_matrix.input_dims[0]), -1),
                          cp_matrix.cores[0])
    for d in range(1, cp_matrix.d):
        result = result.reshape(int(cp_matrix.input_dims[d]), -1, cp_matrix.cores[d].shape[-1])
        result = torch.einsum("ior,idr->dor", cp_matrix.cores[d], result)
    return result.sum(-1).reshape(b, -1)
