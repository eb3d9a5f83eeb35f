"""fetch_crop_share: the share of a decode call's wall time that is
neither parse wait, dispatch nor device wait: the fetch of the RGB to
the host and the crop of each picture (runtime/batch._fetch), in %.

The program's own host-clock waits of each decode call of the window
(BatchStats): the sum of `total_s` less `parse_s`, `entropy_s` and
`device_s`, over the sum of `total_s`."""


def read(ctx):
    stats = ctx.window.stats
    total = sum(s["total_s"] for s in stats)
    if total <= 0:
        return None
    rest = total - sum(s["parse_s"] + s["entropy_s"] + s["device_s"]
                       for s in stats)
    return 100.0 * rest / total
