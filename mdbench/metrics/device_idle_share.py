"""Device layer: 1 - (the union of device-op intervals on each card over
the traced window's wall), in %, the mean of the cards."""


def read(rec):
    cards = rec["trace"]["cards"]
    if not cards or rec["window_s"] <= 0:
        return None
    busy = sum(c["busy_s"] for c in cards.values()) / len(cards)
    return 100.0 * (1.0 - busy / rec["window_s"])
