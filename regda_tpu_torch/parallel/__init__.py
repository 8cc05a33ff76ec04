"""Data parallelism over processes (counterpart of regda_tpu/parallel/)."""

from regda_tpu_torch.parallel.mesh import (DataGroup, all_gather_objects, all_gather_rows, all_reduce_sum,
                                           assert_replicated, average_gradients, barrier,
                                           broadcast_module, broadcast_object,
                                           broadcast_tensors, data_group,
                                           data_group_from_env, data_parallel, shutdown,
                                           global_mean, is_primary, rows, shard_batch, share)

__all__ = ['DataGroup', 'all_gather_objects', 'all_gather_rows', 'all_reduce_sum', 'assert_replicated',
           'average_gradients', 'barrier', 'broadcast_module', 'broadcast_object',
           'broadcast_tensors', 'data_group', 'data_group_from_env', 'data_parallel',
           'global_mean', 'is_primary', 'rows', 'shard_batch', 'share', 'shutdown']
