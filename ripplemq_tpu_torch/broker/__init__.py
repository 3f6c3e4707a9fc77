"""Broker-side planes of the port. Ported so far: the module-level
recovery functions of `broker.dataplane`."""
