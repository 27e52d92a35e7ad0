"""Documents of all shards processed in the window (``process_corpus``,
then ``build_index_corpus``) over the sum of those calls' times."""


def read(run):
    docs, busy = run.counts.get("docs"), run.counts.get("busy_s")
    return None if not docs or not busy else docs / busy
