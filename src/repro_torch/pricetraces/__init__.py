from .synthetic import (N_REGIONS, PriceParams, make_price_traces,
                        price_stats, sample_price_params)

__all__ = ["N_REGIONS", "PriceParams", "make_price_traces", "price_stats",
           "sample_price_params"]
