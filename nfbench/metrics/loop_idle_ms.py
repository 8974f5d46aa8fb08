"""Device-idle milliseconds per train step while the host was in the
trainer's own loop around its train step (`loop.*` spans inside the
iteration's `step.e2e`: the frame's data, the pixel draw and the copies
to the card, the log and its host Pred2GT): the device trace's idle gaps
whose middle lies inside such a span, over the steps. None where the
window holds no such span (a program without it)."""

from nfbench.metrics.search_idle_ms import idle_reader

read = idle_reader("loop")
