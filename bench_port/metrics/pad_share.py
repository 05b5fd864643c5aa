"""pad_share: pad positions (segment id 0) over row positions of the traced
steps' collated batches, in %; nothing where no step padded."""


def read(r):
    if not r.pad_positions:
        return None
    return 100.0 * r.pad_positions / r.row_positions
