from .synthetic import (N_REGIONS, TrafficParams, make_arrival_rate_traces,
                        make_arrival_sets, sample_traffic_params,
                        traffic_stats)

__all__ = [
    "N_REGIONS",
    "TrafficParams",
    "make_arrival_rate_traces",
    "make_arrival_sets",
    "sample_traffic_params",
    "traffic_stats",
]
