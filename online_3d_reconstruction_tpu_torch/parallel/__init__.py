"""The multi-rank paths on ``torch.distributed`` (see ``mesh`` for the
convention every function here follows)."""

from online_3d_reconstruction_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from online_3d_reconstruction_tpu_torch.parallel.ba_sharded import solve_ba_sharded  # noqa: F401
from online_3d_reconstruction_tpu_torch.parallel.frames import batch_disparity  # noqa: F401
from online_3d_reconstruction_tpu_torch.parallel.voxel_sharded import sharded_voxel_downsample  # noqa: F401
from online_3d_reconstruction_tpu_torch.parallel.sgm_sharded import sharded_disparity  # noqa: F401
