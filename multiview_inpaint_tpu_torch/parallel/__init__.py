"""Training steps over the port's networks (one card; DDP waits)."""
