"""The LM's training half: optimizers (``optimizer``), atomic checkpoints
(``checkpoint``) and the fault-tolerant loop (``trainer``)."""
from . import checkpoint, optimizer, trainer  # noqa: F401
