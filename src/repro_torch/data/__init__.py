"""Training data for the port (`pipeline`: the stateless synthetic token
stream of the reference's `data/pipeline.py`)."""
