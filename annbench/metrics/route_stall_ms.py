"""route_stall_ms: device-idle milliseconds a request charged to the
program's ``cnns.route`` span (``CNNSIndex._route``, either router): the
card waits while the host is in the router (``annbench/stalls.py``). The
note gives the whole split of the idle."""

from annbench import stalls


def read(r, records):
    return stalls.stall_ms(r, "cnns.route")
