"""host_post_ms.infer: per call, the host wall of `VideoPipeline.run` after
its chunk's step and readback (`chunk_walls`): mask unpacking, depth
decoding and the FramePredictions; the mean over the window's calls."""


def read(record):
    calls = record["calls"]
    if not calls:
        return None
    return sum(c["wall"] - c["chunk"] for c in calls) / len(calls) * 1e3
