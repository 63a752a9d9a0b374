"""Set-up: process start to the first timed request (imports, kernel build or
load, keys made on the device, key preparation, the encrypted pool, one warm
request)."""


def read(run):
    return run.setup_s
