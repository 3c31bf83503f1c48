"""Training of the port: the softmax / center / triplet trainer and its
checkpoints."""
