"""Paddle nn layers of the port as `torch.nn.Module`s (see `nn/__init__.py`)."""
