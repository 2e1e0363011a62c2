from .synthetic import (N_REGIONS, RegionParams, make_region_traces,
                        sample_region_params, trace_stats)

__all__ = ["N_REGIONS", "RegionParams", "make_region_traces",
           "sample_region_params", "trace_stats"]
