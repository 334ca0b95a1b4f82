"""OSD-side helpers of the erasure-coded data path."""
