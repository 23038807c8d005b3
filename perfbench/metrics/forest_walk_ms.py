"""The forest walk alone: CUDA events around ``proba_device`` of the
served forest on a served cloud's feature rows (``extract_device``),
milliseconds a call.  Nothing to read where the classifier is no
forest."""


def read(records):
    clf = records["classifier"]
    return clf.get("walk_ms") if clf["kind"] == "rpte" else None
