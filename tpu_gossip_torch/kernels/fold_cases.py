"""Crafted class tables for K2's whole-plan fold, shared by its CPU and
card tests and ``chip_smoke.py`` (pure Python): position-major
and node-major classes mixed; pad_deg 1, 12, 31, 32, 33 and over 1024;
count 1; node gaps before the first class, between classes and up to
n_out."""

CRAFTED = {  # name: ([(node_off, count, pad_deg), ...] in node order, n_out)
    "mixed": ([(0, 8192, 2), (8192, 5, 1), (8197, 7, 31), (8204, 3, 32), (8207, 4, 33), (8211, 2, 1500),
               (8213, 1, 37)], 8300),
    "gaps": ([(3, 9000, 3), (9010, 1, 31), (9011, 2, 1025), (9020, 40, 33), (9060, 8192, 1), (17300, 1, 1)], 17400),
    "node_major": ([(0, 300, 12), (300, 129, 32), (429, 1, 4096), (430, 3, 5000), (440, 1, 1024)], 441),
}


def crafted_classes(name: str) -> tuple[tuple, int, int]:
    """(classes, rows, n_out) of a crafted table: count >= 8192 is
    position-major (1024-aligned slot_off and cstride), else node-major;
    rows a multiple of 8."""
    spec, n_out = CRAFTED[name]
    classes, slot = [], 0
    for node_off, count, pad_deg in spec:
        if count >= 8192:
            slot = -(-slot // 1024) * 1024
            cstride = -(-count // 1024) * 1024
        else:
            cstride = count
        classes.append((node_off, slot, count, pad_deg, cstride))
        slot += pad_deg * cstride
    return tuple(classes), -(-slot // 1024) * 8, n_out
