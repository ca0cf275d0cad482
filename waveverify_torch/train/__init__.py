"""Training of the port: the composite forward, the train and validation
steps, the loop, checkpoints and the CLI (``python -m
waveverify_torch.train``); and the host input pipeline."""
