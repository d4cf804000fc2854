"""Device ms per batch of host-to-device copies (the uploader's), from the
traced segment; None where no batch crosses the host link."""

from benchmark.metrics import device_ms


def read(ctx):
    return device_ms(ctx, lambda name: "memcpy htod" in name.lower())
