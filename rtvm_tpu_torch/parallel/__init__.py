"""Multi-device execution (counterpart of ``rtvm_tpu/parallel``)."""

from rtvm_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
