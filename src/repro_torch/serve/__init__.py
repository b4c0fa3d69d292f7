"""Serving of the port: the paged engine and the continuous batcher."""
from .engine import ServeConfig  # noqa: F401
from .kvpool import KVPool, PageError  # noqa: F401
from .scheduler import Batcher, ContinuousBatcher  # noqa: F401
