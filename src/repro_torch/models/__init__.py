from .model import Model, input_specs  # noqa: F401
from . import attention, layers, transformer  # noqa: F401
