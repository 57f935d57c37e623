"""A closed loop: one client steps the whole fleet in lock step, so each
tick is due as soon as the plant step after the previous one is done."""


def due(traffic: dict, j: int, w0: float, now: float) -> float:
    return now
