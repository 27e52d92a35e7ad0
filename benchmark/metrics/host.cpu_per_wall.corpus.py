"""Host CPU seconds per wall second of the window's calls: the change in
``time.process_time()`` over each ``process_corpus`` + ``build_index_corpus``
call, summed, over the calls' summed time (above 1 where several threads
work)."""


def read(run):
    busy, cpu = run.counts.get("busy_s"), run.counts.get("cpu_s")
    return None if not busy or cpu is None else cpu / busy
