"""The jobs a traffic mix can run, one module each, with a ``Job`` class:
``setup`` (inputs from the seed, the program built and warmed up),
``unit`` (one unit of work; False where it gave non-finite output),
``end_to_end`` (the cell's end-to-end numbers from the units' walls),
``counters``, ``info`` and ``timings`` (for the per-layer readers),
``release`` (the program's state freed) and ``check`` (the comparison with
the plain reference that decides ``correct``)."""
