"""Entries: one file a program entry point, named by the ``entry`` key of
a configuration.  Each defines ``Entry(config, traffic, seed, workdir,
device, chips)`` with ``setup()``, ``search(tag) -> work``, ``problem()``
and ``check(device) -> (numbers, facts)``; ``chips`` is the cell's card
count, which every search of the program is to run on."""
