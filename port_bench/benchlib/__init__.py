"""The port benchmark's yardstick: traffic, work counts, trace reading,
the wire format and the run of one cell."""
