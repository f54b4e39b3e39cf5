"""Entries: one file a program entry point, named by the ``entry`` key of
a configuration.  Each defines ``Entry(config, traffic, seed, workdir,
device)`` with ``setup()``, ``search(tag) -> work``, ``problem()`` and
``check(device) -> (numbers, facts)``."""
