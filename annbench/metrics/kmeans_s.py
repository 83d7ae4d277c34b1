"""kmeans_s: seconds of the k-means stage of ``build_cnns``
(``models/kmeans.py``), from the program's own stage timer
(``stage_seconds["kmeans"]``: the upload of the rows, the Lloyd
iterations and the assignment's copy to the host)."""


def read(r, records):
    return r.setup.get("kmeans_s")
