"""device_idle.teps: the device's idle share of the SSSP cells' traced calls."""
from gblib.readers import device_idle as read  # noqa: F401
