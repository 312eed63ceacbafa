"""Distribution context, partition specs, the arena's flat sharding and
block placement over the fabric's logical devices."""
from repro_torch.sharding.partition import (DistContext,
                                            batch_partition_specs,
                                            make_dist_ctx,
                                            param_partition_specs,
                                            single_device_ctx,
                                            state_partition_specs)

__all__ = ["DistContext", "batch_partition_specs", "make_dist_ctx",
           "param_partition_specs", "single_device_ctx",
           "state_partition_specs"]
