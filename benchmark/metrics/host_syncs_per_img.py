"""host_syncs_per_img: the host's waits on the device in the traced window
(cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize and
blocking cudaMemcpy calls in the trace) per image."""


def read(out):
    t = out.get("trace")
    if not t or not t["images"]:
        return None
    return t["syncs"] / t["images"]
