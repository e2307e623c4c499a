"""Data parallelism and batched inference over ``torch.distributed``
(counterpart of ``dgp_tpu/parallel``)."""

from .data_parallel import (
    make_data_parallel_elbo,
    make_data_parallel_loss,
    make_data_sample_parallel_elbo,
    make_multislice_elbo,
)
from .serving import (
    pad_rows,
    predict_in_chunks,
    run_sharded,
    sharded_gpr_predict_y,
    sharded_predict_f,
    sharded_predict_y,
    sharded_predict_y_em,
    sharded_predict_y_mf,
    sharded_predict_y_mo,
    sharded_rowwise,
)
from .mesh import (
    make_mesh,
    make_mesh_2d,
    make_mesh_multislice,
    pad_to_multiple,
    replicate,
    shard_batch,
)
