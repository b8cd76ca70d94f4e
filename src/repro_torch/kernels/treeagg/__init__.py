from . import kernel, ops, ref
