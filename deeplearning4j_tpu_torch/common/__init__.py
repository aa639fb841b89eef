from .device import card_numerics, resolve_device, to_port, to_public
from .resilience import (FaultInjected, FaultInjector, NonRetryableError,
                         RetryPolicy)

__all__ = ["FaultInjected", "FaultInjector", "NonRetryableError",
           "RetryPolicy", "card_numerics", "resolve_device", "to_port",
           "to_public"]
