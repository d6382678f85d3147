"""Traffic kinds (one module each) and traffic mixes (one JSON file each)."""
