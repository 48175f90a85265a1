"""Counterpart of ``tntorch_tpu.parallel``, for what one card needs.

Only ``tt_batch_forward`` (TT evaluation at a batch of coordinate rows, on
the card's ``tt_eval`` kernels) is ported. The meshes, dp/tp sharding and
sharded algorithms are not ported this round (ROADMAP.md, queue 1 item 12):
every other name raises `ParallelNotPorted`.
"""

from tntorch_tpu_torch.ops.tt_eval import tt_batch_forward


class ParallelNotPorted(NotImplementedError):
    """A name of ``tntorch_tpu.parallel`` (or a ``mesh=`` argument) that the
    port does not have (ROADMAP.md, queue 1 item 12)."""

    def __init__(self, what: str):
        super().__init__(f"{what} is not ported: the port runs on one card "
                         "(ROADMAP.md, queue 1 item 12)")


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise ParallelNotPorted(f"tn.parallel.{name}")


__all__ = ["ParallelNotPorted", "tt_batch_forward"]
