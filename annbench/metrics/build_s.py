"""build_s: seconds of ``build_cnns`` in set-up, host array to device
index, on the harness's clock around the call, synchronised before and
after. Paid inside ``setup_s``."""


def read(r, records):
    return r.setup.get("build_s")
