from pnpflow_tpu_torch.parallel.mesh import (
    all_reduce_grads, devices, fan_out, gather, init_distributed,
    process_batch_slice, replicate, shard_batch)

__all__ = ["all_reduce_grads", "devices", "fan_out", "gather",
           "init_distributed", "process_batch_slice", "replicate",
           "shard_batch"]
