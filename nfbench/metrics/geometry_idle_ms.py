"""Device-idle milliseconds per train step while the host was in a list
backend's conv geometry (`particle_net.geometry` spans: the two adjoint
plans, `cconv_geometry` and `cconv_tap_matrix`), read as
`search_idle_ms` reads the searches. None where the window holds no
such span (a program without it)."""

from nfbench.metrics.search_idle_ms import idle_reader

read = idle_reader("particle_net.geometry")
