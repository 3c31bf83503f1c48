"""The harness: manifest, seeds, weights, images, tracing and the work
counters, shared by every driver."""
