"""Mean host time of the replay buffer's add over the window
(``AdaptationRunner.host_times["add"]``; the target buffer full at 300, so
every add that is taken evicts), in ms."""


def read(record):
    adds = record.get("add_s")
    return sum(adds) / len(adds) * 1e3 if adds else None
