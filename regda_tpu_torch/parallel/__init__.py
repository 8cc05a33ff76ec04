"""Data and spatial parallelism over processes (counterpart of regda_tpu/parallel/)."""

from regda_tpu_torch.parallel.mesh import (DataGroup, all_gather_objects, all_gather_rows,
                                           all_reduce_max, all_reduce_sum, assert_replicated,
                                           average_gradients, barrier, broadcast_module,
                                           broadcast_object, broadcast_tensors, check_height,
                                           data_group, data_group_from_env, data_parallel,
                                           gather_height, global_mean, halo_exchange,
                                           height_rows, is_primary, rows, shard_batch, share,
                                           shutdown, spatial_sum)

__all__ = ['DataGroup', 'all_gather_objects', 'all_gather_rows', 'all_reduce_max',
           'all_reduce_sum', 'assert_replicated', 'average_gradients', 'barrier',
           'broadcast_module', 'broadcast_object', 'broadcast_tensors', 'check_height',
           'data_group', 'data_group_from_env', 'data_parallel', 'gather_height',
           'global_mean', 'halo_exchange', 'height_rows', 'is_primary', 'rows',
           'shard_batch', 'share', 'shutdown', 'spatial_sum']
