"""Host helpers shared by the port's maps and stores."""
