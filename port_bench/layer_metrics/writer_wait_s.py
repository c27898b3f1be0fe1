"""writer_wait_s: seconds a unit in which the xrays program's phase 1
waited on its writer thread: the program's spans ``gft.writer.put`` (the
trace's rows queued while the writer's queue is full) and
``gft.writer.close`` (the last rows drained) inside ``gft.xrays.trace``."""

from port_bench import program_spans


def read(trace):
    return program_spans.seconds_per_unit(
        trace, ("gft.writer.put", "gft.writer.close"),
        inside="gft.xrays.trace")
