"""scan and IO: the mean host milliseconds a query spends inside the
executor's ``read_parquet``, ``read_relation_files`` and
``iter_dataset_chunks`` (outermost call per thread, a generator per item;
calls opened in the window, over the queries answered in it). A window in
which every read was a buffer-pool hit reads 0."""


def read(r):
    if not r.queries:
        return None
    return 1000.0 * r.scan_read_s / len(r.queries)
