"""The Paddle eager core of the port: dtypes, `Tensor` and autograd."""
