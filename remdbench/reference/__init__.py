"""The plain reference of the benchmark, in modules a configuration
selects by its own fields (``checks``): ``system_<kind>``,
``model_<model>``, ``exchange_<scheme>``, ``pattern_<pattern>``, with the
threefry draws (``prng``), the control grid (``controls``) and the units
they share.  It imports nothing of the program under test."""
