"""Device-idle milliseconds per train step while the host was in a list
backend's neighbour searches (`particle_net.search` spans: the fluid and
box searches, their cell grids included): the device trace's idle gaps
whose middle lies inside such a span, over the steps. None where the
window holds no such span (a program without it)."""

from nfbench import spans


def idle_reader(layer: str):
    """The reader of the idle ms per step inside `layer`'s spans."""

    def read(run):
        if run.unit != "step" or not spans.count_per_unit(run, layer):
            return None
        return spans.idle_ms_per_unit(run, layer)

    return read


read = idle_reader("particle_net.search")
