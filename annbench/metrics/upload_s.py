"""upload_s: seconds of the upload stage of ``build_cnns``, from the
program's own stage timer (``stage_seconds["upload"]``, span
``cnns.build.upload``: the rows' copy to the card, synchronised; inside
``kmeans_s``). Paid inside ``setup_s``. Nothing to read where the
program or the system file gives no such stage."""


def read(r, records):
    return r.setup.get("upload_s")
