"""Telemetry plane of the port: `obs.lockwitness` (the runtime lock
witness whose named factories every lock-owning module uses),
`obs.metrics` (counters, histograms, the stage clock), `obs.trace` (the
flight recorder), `obs.spans` (the causal-tracing span ring),
`obs.postmortem` (the postmortem bundles) and `obs.assemble` (span
records into per-message critical-path trees). Not imported here: the factories must stay import-light so every
lock-owning module can use them."""
