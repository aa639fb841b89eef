from .device import card_numerics, resolve_device, to_port, to_public

__all__ = ["card_numerics", "resolve_device", "to_port", "to_public"]
