"""Testing aids of the port: deterministic fault injection (`faults`),
and a drill of every eager collective across rank processes
(`collective_drill`)."""
