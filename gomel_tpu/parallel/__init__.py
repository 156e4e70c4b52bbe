"""Distribution layer: mesh setup, data-parallel batching, frame sharding.

The reference is single-process/single-core (SURVEY.md §2.6); this package is
the scale-out subsystem: ``('data','frame')`` meshes, NamedSharding
batch pipelines, and shard_map halo-exchange kernels for long-form audio.
"""
from .mesh import (
    DATA_AXIS,
    FRAME_AXIS,
    batch_frame_sharding,
    data_group_for_process,
    data_sharding,
    host_to_global,
    initialize_multihost,
    is_multihost,
    local_rows_to_global,
    make_mesh,
    process_local_batch_multiple,
    replicated,
    single_device_mesh,
)
from .batch import (
    BatchedMel,
    BatchedPhase,
    Bucket,
    local_rows,
    make_buckets,
    pad_batch_to_multiple,
)
from .sharded import (
    FrameShardPlan,
    pad_frames_for_plan,
    pad_signal_for_plan,
    plan_frame_sharding,
    sharded_gl_noise_fn,
    sharded_griffin_lim_fn,
    sharded_istft_fn,
    sharded_mel_decode_fn,
    sharded_mel_encode_fn,
    sharded_phase_decode_fn,
    sharded_phase_encode_fn,
    sharded_stft_fn,
)

__all__ = [
    "DATA_AXIS", "FRAME_AXIS", "make_mesh", "single_device_mesh",
    "data_sharding", "batch_frame_sharding", "replicated",
    "initialize_multihost", "is_multihost",
    "data_group_for_process",
    "host_to_global", "local_rows_to_global", "process_local_batch_multiple",
    "BatchedMel", "BatchedPhase", "Bucket", "local_rows", "make_buckets",
    "pad_batch_to_multiple",
    "FrameShardPlan", "plan_frame_sharding", "pad_signal_for_plan",
    "pad_frames_for_plan", "sharded_stft_fn", "sharded_istft_fn",
    "sharded_gl_noise_fn", "sharded_griffin_lim_fn",
    "sharded_mel_encode_fn", "sharded_mel_decode_fn",
    "sharded_phase_encode_fn", "sharded_phase_decode_fn",
]
