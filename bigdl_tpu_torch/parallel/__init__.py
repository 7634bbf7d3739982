"""bigdl_tpu_torch.parallel: data, fully sharded data and tensor
parallelism over ``torch.distributed`` (counterpart of
``bigdl_tpu.parallel``). Sequence, pipeline and expert parallelism are not
ported yet (ROADMAP.md queue 1 entry 13(b))."""

from bigdl_tpu_torch.parallel.data_parallel import (DataParallel,
                                                    FullyShardedDataParallel,
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
                                           local_mesh, make_hybrid_mesh,
                                           make_mesh)
from bigdl_tpu_torch.parallel.tensor_parallel import (TensorParallel,
                                                      megatron_specs,
                                                      replicated_specs)

__all__ = ["init_distributed", "make_mesh", "make_hybrid_mesh",
           "local_mesh", "Mesh", "DataParallel", "FullyShardedDataParallel",
           "TensorParallel", "megatron_specs", "replicated_specs",
           "feeds_rank_part", "COMPRESS_MODES",
           "DEFAULT_BUCKET_BYTES", "GradCommConfig", "BucketPlan",
           "make_grad_comm_config", "build_bucket_plan", "apply_grad_comm",
           "compressed_psum"]
