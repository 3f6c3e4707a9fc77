"""Telemetry plane of the port: `obs.lockwitness` (the runtime lock
witness whose named factories every lock-owning module uses),
`obs.metrics` (counters, histograms, the stage clock), `obs.trace` (the
flight recorder) and `obs.spans` (the causal-tracing span ring). The
postmortem bundles and the span assembler come with a later slice. Not
imported here: the factories must stay import-light so every
lock-owning module can use them."""
