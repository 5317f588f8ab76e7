"""serving: the share of the window's completed queries that ran as a
member of a literal sweep (the frontend's ``batched_queries`` over its
``completed``, counter deltas over the window)."""


def read(r):
    done = r.serving.get("completed", 0)
    return 100.0 * r.serving.get("batched_queries", 0) / done if done else None
