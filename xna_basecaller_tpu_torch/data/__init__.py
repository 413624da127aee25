"""Host-side data: chunking, simulation, fast5 reading, writers."""
