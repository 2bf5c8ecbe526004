"""The device memory the window's allocations reached at their peak
(``torch.cuda.max_memory_allocated()``, reset at the window's start), in
GiB."""


def read(r):
    if not r['peak_bytes']:
        return None
    return r['peak_bytes'] / 2 ** 30
