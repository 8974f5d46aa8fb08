"""Device-idle milliseconds per train step while the host was in a
ParticleNet step (`particle_net` spans, the plan and sorts included):
the device trace's idle gaps whose middle lies inside such a span, over
the steps."""

from nfbench import spans


def read(run):
    if run.unit != "step":
        return None
    return spans.idle_ms_per_unit(run, "particle_net")
