"""The benchmark's yardstick: peaks, operation and byte counts, traffic
generation, trace reduction and the comparison that decides ``correct``.
Nothing here imports the program under test."""
