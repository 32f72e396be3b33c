"""train_img_per_s: images trained in the window over the window's length
(host clock, the device synchronised at its close)."""


def read(out):
    if out["kind"] != "train" or out["window_s"] <= 0:
        return None
    return out["images"] / out["window_s"]
