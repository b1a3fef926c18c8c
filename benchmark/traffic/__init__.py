"""Traffic: the generators and the mixes' parameter files."""
