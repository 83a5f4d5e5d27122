"""Traffic drivers: one general generator per kind of mix, named by a traffic file."""
