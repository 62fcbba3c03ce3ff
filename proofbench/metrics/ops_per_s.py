"""Operations proven per second: every operation of every proof in the
window over the window, from the first proof's start to the last one's end."""


def read(record):
    if not record.get("proofs"):
        return None
    return record["ops"] / record["window_s"]
