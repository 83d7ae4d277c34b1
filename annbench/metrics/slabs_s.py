"""slabs_s: seconds of ``build_cnns`` after k-means, from the program's
own stage timer (``stage_seconds["slabs"]``, span ``cnns.build.slabs``:
the slab layout, the representatives, the replica fill and the slab
pack, up to the return, synchronised). Paid inside ``setup_s``. Nothing
to read where the program or the system file gives no such stage."""


def read(r, records):
    return r.setup.get("slabs_s")
