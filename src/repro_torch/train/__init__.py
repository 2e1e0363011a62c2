"""Training for the port: the train step (`step`), AdamW (`optimizer`),
gradient compression (`compression`), checkpoints (`checkpoint`) and the
carbon-aware trainer (`carbon_aware`), the ports of the reference's
`train/`.  No kernel runs in a train step: each model's loss is its plain
path, differentiated by autograd."""
