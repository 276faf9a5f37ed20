"""Work assignment across the hosts of a corpus job."""
