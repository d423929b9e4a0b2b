"""launches_per_scan: device records (kernels, copies, fills) of the
traced units over the scans they registered."""


def read(ctx):
    if not ctx.records or not ctx.scans:
        return None
    return len(ctx.records) / ctx.scans
