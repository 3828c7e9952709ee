"""The LM side path of the port.  Only the decode-attention functions
(``attention``) are ported so far."""
