"""What each kernel's call needs, by its shapes: bytes with every input read
once and every output written once, and operations; and the card's
published peaks.  One file a kernel, named by the kernel."""
