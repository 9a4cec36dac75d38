"""Device time of the host-to-device copies of one eval call, in ms."""


def read(reading):
    s = reading["trace"]["h2d_s"]
    return s / reading["traffic"]["trace_calls"] * 1e3 if s > 0 else None
