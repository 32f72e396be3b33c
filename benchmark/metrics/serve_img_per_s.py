"""serve_img_per_s: requests whose detections reached the host before the
window closed, from all clients, over the window's length."""


def read(out):
    if out["kind"] != "serve" or out["window_s"] <= 0:
        return None
    return out["images"] / out["window_s"]
