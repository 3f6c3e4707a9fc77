"""Telemetry plane of the port. Ported so far: `obs.lockwitness`, the
runtime lock witness whose named factories the stores create their locks
through. The metrics registry, flight recorder and postmortem bundles
come with the DataPlane slice. Not imported here: the factories must
stay import-light so every lock-owning module can use them."""
