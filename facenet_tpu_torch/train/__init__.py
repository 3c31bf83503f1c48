"""Training of the port: the softmax / center / triplet trainer and its
checkpoints, the pair-classifier trainer and the MTCNN stage trainer."""
