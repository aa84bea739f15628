"""The port's copy of the serialization schema (`lol.proto`) and its wire
codec (`wire`), which imports no protobuf runtime."""
