"""Runnable sample apps — the end-to-end exercisers.

Parity with the reference's only demo programs (reference:
sample-producer/src/main/java/org/example/Main.java:31-38 — two messages
to topic1 at one per second; sample-consumer/src/main/java/org/example/
Main.java:18-42 — poll a topic every second and print). Run against a
live cluster:

    python -m ripplemq_tpu_torch.samples.producer --bootstrap localhost:9092
    python -m ripplemq_tpu_torch.samples.consumer --bootstrap localhost:9092

Twin of `ripplemq_tpu/samples/__init__.py` (PyTorch port): the same code,
importing only the port's modules.
"""
