"""Operations proven per second in the traced run: every operation of every
proof in the window over the window.  The traced run's spans and scopes
synchronise, so it reads a little below an untraced run's rate."""


def read(record):
    if not record.get("proofs"):
        return None
    return record["ops"] / record["window_s"]
