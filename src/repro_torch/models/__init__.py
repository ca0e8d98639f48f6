from .model import Model  # noqa: F401
from . import attention, layers, transformer  # noqa: F401
