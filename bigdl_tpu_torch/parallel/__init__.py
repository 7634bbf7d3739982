"""bigdl_tpu_torch.parallel: data parallelism over ``torch.distributed``
(counterpart of the data-parallel half of ``bigdl_tpu.parallel``). Tensor,
sequence, pipeline and fully sharded data parallelism are not ported yet
(ROADMAP.md queue 1)."""

from bigdl_tpu_torch.parallel.data_parallel import (DataParallel,
                                                    feeds_rank_part)
from bigdl_tpu_torch.parallel.grad_comm import (COMPRESS_MODES,
                                                DEFAULT_BUCKET_BYTES,
                                                BucketPlan, GradCommConfig,
                                                apply_grad_comm,
                                                build_bucket_plan,
                                                compressed_psum)
from bigdl_tpu_torch.parallel.grad_comm import \
    make_config as make_grad_comm_config
from bigdl_tpu_torch.parallel.mesh import (Mesh, init_distributed,
                                           local_mesh, make_mesh)

__all__ = ["init_distributed", "make_mesh", "local_mesh", "Mesh",
           "DataParallel", "feeds_rank_part", "COMPRESS_MODES",
           "DEFAULT_BUCKET_BYTES", "GradCommConfig", "BucketPlan",
           "make_grad_comm_config", "build_bucket_plan", "apply_grad_comm",
           "compressed_psum"]
