"""Training of the port: state and optimizers, the iteration, the training loop."""
