"""Device ms of the program's ``upload`` span, on the uploader's stream:
``upload_ms`` seen from inside; None where no batch crosses the host link."""

from benchmark.spans import mean


def read(ctx):
    return mean(ctx, "upload")
