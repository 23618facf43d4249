"""Frozen operation and byte counts: the yardstick of the roofline and peak
shares. They are worked out here from shapes, and import nothing of the
port, so a change to a kernel cannot move them."""
