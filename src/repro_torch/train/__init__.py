"""Surrogate-gradient training of the eCNN, counterpart of
``repro.train``: the loop (`train.snn_loop`), atomic step checkpoints
(`train.checkpoint`) and fault hooks (`train.fault`)."""
