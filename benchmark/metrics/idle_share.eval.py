"""Share of the traced stretch in which no kernel, copy or memset ran on
the card, in %."""

from benchmark.readings import idle_share


def read(reading):
    return idle_share(reading)
