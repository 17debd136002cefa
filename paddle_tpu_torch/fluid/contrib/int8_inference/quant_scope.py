def noop():
    return None
