"""Engine bindings and the host plane (PyTorch port): `parallel.engine`,
the single-device local binding; `parallel.shmring` and
`parallel.hostplane`, the multi-core host plane's shared-memory rings
and worker subprocesses. Nothing is imported here: the host plane's
workers import `parallel.hostplane` and must stay torch-free."""
