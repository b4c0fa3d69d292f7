from .checkpointer import Checkpointer  # noqa: F401
